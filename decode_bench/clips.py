"""The cell's input: clips made from the seed by the traffic mix's builder.

A traffic mix (traffic/<mix>.json) names a builder kind; gen/<kind>.py
holds that builder, which makes one Annex-B clip with the benchmark's
own test encoder (refdec.testenc) from three functions of
(config, traffic, seed): `pocs` (its pictures' POCs in coding order),
`headers` (the parameter sets before the first picture) and
`picture(..., f, shape)` (the NAL units of the f-th picture), each
picture on its own, so the pictures of a run's clips are made in a pool
of worker processes (pool.py).  The mix gives the clip count, the
pictures a clip, the QP and the encoder's decision probabilities; the
configuration gives the picture size, the CTU and the bit depth.  Clip i
of a run takes the i-th seed that `clip_seeds` draws from the run's
seed, so every seed gives the same number of clips of the same size and
kind, with other content.

A mix with a `shape_seed` also gives every seed the same work.  Each
picture slot of a run has a shape: its partition, each CU's kind (intra,
inter, skip, merge), which blocks carry a residual and how many
coefficients each draws, and the CTUs' SAO and ALF switches
(`shaped_decisions`).  Clip i's shapes are a fixed set drawn from the
mix's `shape_seed` and i; its first picture (a join's) keeps its shape
and the others trade theirs in an order drawn from the clip's seed.
The clip's seed gives all the rest: modes, vectors, indices, the
coefficients' places, levels and signs, the filters' parameters.  The
partition alone made one seed's pictures ~20% faster to decode than
another's.  Without `shape_seed` the seed gives both, as the
repository's stream builders do.

Clips are kept under the cache directory, keyed by the configuration,
the mix, the builder, the test encoder's sources, the clip's place and
its seed.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import random
from dataclasses import dataclass

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


@dataclass
class Clip:
    """One clip: its bytes, its access units and their POCs."""

    stream: bytes
    aus: list
    pocs: list
    seed: int

    @property
    def key(self) -> str:
        return hashlib.sha256(self.stream).hexdigest()[:24]


def parameter_sets(sps, pps) -> bytes:
    """SPS and PPS NAL units of the test encoder's `sps` and `pps`."""
    from refdec.bitstream.nal import NalUnitType
    from refdec.testenc.bitwriter import BitWriter
    from refdec.testenc.hls_writer import make_nal, write_pps, write_sps
    bw = BitWriter()
    write_sps(bw, sps)
    st = make_nal(NalUnitType.SPS, bw.bytes())
    bw = BitWriter()
    write_pps(bw, pps, sps)
    return st + make_nal(NalUnitType.PPS, bw.bytes())


def access_units(stream: bytes) -> list:
    """The stream cut into access units: each VCL NAL with the non-VCL
    NALs before it (one slice a picture); trailing non-VCL NALs join the
    last unit."""
    from refdec.bitstream.nal import is_vcl, split_annexb
    nals = split_annexb(stream)
    # each NAL with its start code (3 bytes, or 4 with a zero before)
    starts = [0] + [off - 4 if stream[off - 4] == 0 else off - 3
                    for off, _ in nals[1:]]
    units, cur = [], b""
    for (off, _), a, b in zip(nals, starts, starts[1:] + [len(stream)]):
        cur += stream[a:b]
        if is_vcl(stream[off + 1] >> 3):
            units.append(cur)
            cur = b""
    if cur:
        units[-1] += cur
    if b"".join(units) != stream:
        raise ValueError("access units do not rejoin into the stream")
    return units


def clip_seeds(seed: int, n: int) -> list:
    """The seeds of a run's n clips, drawn from the run's seed."""
    rng = random.Random(seed)
    return [rng.randrange(1, 10 ** 6) for _ in range(n)]


def picture_shapes(traffic: dict, clip: int, seed: int, kinds: list
                   ) -> list:
    """The shape seed of each picture of clip `clip` whose seed is
    `seed` and whose pictures are of `kinds`, or Nones for a mix without
    `shape_seed`.  The first picture keeps the set's first shape; the
    others trade shapes with the pictures of their kind."""
    if "shape_seed" not in traffic:
        return [None] * len(kinds)
    base = traffic["shape_seed"] * 10 ** 4 + clip * len(kinds)
    order = list(range(len(kinds)))
    rng = random.Random(seed)
    for kind in sorted(set(kinds[1:])):
        slots = [f for f in range(1, len(kinds)) if kinds[f] == kind]
        moved = list(slots)
        rng.shuffle(moved)
        for f, g in zip(slots, moved):
            order[f] = g
    return [base + g for g in order]


def shaped_decisions(seed: int, shape: int | None, decisions: dict):
    """The test encoder's decisions for one picture: RandomDecisions of
    `seed` where `shape` is None; else one whose amount of work comes
    from `shape` and whose values come from `seed`.

    The shape's generator decides the splits, the mode constraint, skip,
    intra or inter, merge, the root CBF, whether a block has a residual
    and what share of its samples its coefficients are drawn over, and
    each CTU's SAO and its ALF and CC-ALF switches.  Each of these is
    drawn from choices that depend on the shape alone, so a shape gives
    one partition whatever the seed."""
    from refdec.testenc.encoder import RandomDecisions
    if shape is None:
        return RandomDecisions(seed=seed, **decisions)

    class ShapedDecisions(RandomDecisions):
        def __init__(self):
            super().__init__(seed=seed, **decisions)
            self.shape_rnd = random.Random(shape)

        def _shaped(self, name, *args):
            content, self.rnd = self.rnd, self.shape_rnd
            try:
                return getattr(RandomDecisions, name)(self, *args)
            finally:
                self.rnd = content

        def split(self, node, allowed):
            return self._shaped("split", node, allowed)

        def mode_cons_intra(self, node):
            return self._shaped("mode_cons_intra", node)

        def cu_skip(self, cu):
            return self._shaped("cu_skip", cu)

        def pred_mode(self, cu):
            return self._shaped("pred_mode", cu)

        def merge_flag(self, cu):
            return self._shaped("merge_flag", cu)

        def root_cbf(self, cu):
            return self._shaped("root_cbf", cu)

        def sao(self, cx, cy, luma_on, chroma_on, coder):
            return self._shaped("sao", cx, cy, luma_on, chroma_on, coder)

        def alf(self, cx, cy, coder):
            # RandomDecisions.alf, its switches drawn from the shape and
            # its filter indices from the seed (their ranges are the
            # seed's APSs')
            sh, cs = coder.sh, coder.cs
            s, r = self.shape_rnd, self.rnd
            prob = getattr(self, "alf_prob", 0.6)
            out = {"enable": [0, 0, 0], "filt_idx": 0, "alt": [0, 0],
                   "cc": [0, 0]}
            for c in range(3):
                if s.random() < prob and sh.alf_enabled[c]:
                    out["enable"][c] = 1
            out["filt_idx"] = r.randrange(16 + sh.num_alf_aps_ids_luma)
            if sh.alf_enabled[1] or sh.alf_enabled[2]:
                n_alts = cs.alf_apss[sh.alf_aps_id_chroma] \
                    .alf.num_alternatives_chroma
                out["alt"] = [r.randrange(n_alts), r.randrange(n_alts)]
            for k, (on, aid) in enumerate((
                    (sh.ccalf_cb_enabled, sh.ccalf_cb_aps_id),
                    (sh.ccalf_cr_enabled, sh.ccalf_cr_aps_id))):
                if s.random() < prob and on:
                    cnt = cs.alf_apss[aid].cc_alf.filter_count[k]
                    out["cc"][k] = r.randint(1, cnt)
            return out

        def coeffs(self, tu, cu, comp):
            if self.shape_rnd.random() > self.cbf_prob:
                return None
            share = self.shape_rnd.random()
            x, y, w, h = tu.blocks[comp]
            blk = np.zeros((h, w), dtype=np.int32)
            n = max(1, int(w * h * self.density * share))
            # as RandomDecisions.coeffs: low frequencies, inside the
            # zero-out region
            wmax, hmax = min(w, 32), min(h, 32)
            if cu.sbt_info and comp == 0:
                wmax, hmax = min(wmax, 16), min(hmax, 16)
            for _ in range(n):
                cx = min(int(self.rnd.expovariate(0.25)), wmax - 1)
                cy = min(int(self.rnd.expovariate(0.25)), hmax - 1)
                blk[cy, cx] = self.rnd.randint(1, self.max_level) * \
                    (1 if self.rnd.random() < 0.5 else -1)
            if not np.any(blk):
                blk[0, 0] = 1
            return blk

    return ShapedDecisions()


_BUILDERS: dict = {}


def load_builder(kind: str):
    """The module gen/<kind>.py."""
    if kind not in _BUILDERS:
        path = os.path.join(HERE, "gen", kind + ".py")
        spec = importlib.util.spec_from_file_location(
            f"decode_bench_gen_{kind}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _BUILDERS[kind] = mod
    return _BUILDERS[kind]


def kinds_of(kind: str, config: dict, traffic: dict) -> list:
    """The builder's kind of each picture of a clip (its `kinds`), or one
    kind for all: pictures trade shapes only with pictures of their
    kind."""
    b = load_builder(kind)
    n = len(b.pocs(config, traffic))
    if hasattr(b, "kinds"):
        return list(b.kinds(config, traffic))
    return ["picture"] * n


def build_clip(kind: str, config: dict, traffic: dict, seed: int,
               clip: int = 0) -> tuple[bytes, list]:
    """(Annex-B clip, its POCs in coding order), made in this process;
    `clip` is its place in the run."""
    b = load_builder(kind)
    pocs = b.pocs(config, traffic)
    shapes = picture_shapes(traffic, clip, seed,
                            kinds_of(kind, config, traffic))
    return (b.headers(config, traffic, seed)
            + b"".join(b.picture(config, traffic, seed, f, shapes[f])
                       for f in range(len(pocs))), pocs)


def picture_of(job) -> bytes:
    """The NAL units of one picture: job = (kind, config, traffic, clip
    seed, picture index, shape seed or None)."""
    kind, config, traffic, seed, f, shape = job
    return load_builder(kind).picture(config, traffic, seed, f, shape)


def _sources_digest(kind: str, config: dict, traffic: dict) -> str:
    h = hashlib.sha256(json.dumps([config, traffic], sort_keys=True)
                       .encode())
    paths = [os.path.join(HERE, "gen", kind + ".py"),
             os.path.join(HERE, "clips.py")]
    enc = os.path.join(HERE, "refdec", "testenc")
    paths += sorted(os.path.join(enc, f) for f in os.listdir(enc)
                    if f.endswith(".py"))
    for p in paths:
        with open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:24]


def make_clips(config: dict, traffic: dict, seed: int,
               cache_dir: str | None, workers: int = 1) -> list:
    """The run's clips, read from `cache_dir` or made, their pictures in
    a pool of `workers` processes."""
    kind = traffic["kind"]
    b = load_builder(kind)
    pocs = b.pocs(config, traffic)
    if len(set(pocs)) != len(pocs):
        raise ValueError(f"{kind}: a clip's POCs must differ")
    digest = _sources_digest(kind, config, traffic)
    seeds = clip_seeds(seed, traffic["clips"])
    kinds = kinds_of(kind, config, traffic)
    slots = list(enumerate(seeds))
    paths = [None if cache_dir is None else
             os.path.join(cache_dir, "clips", f"{digest}_{i}_{s}")
             for i, s in slots]
    streams = {}
    for slot, path in zip(slots, paths):
        if path is not None and os.path.exists(path + ".json"):
            with open(path + ".266", "rb") as f:
                streams[slot] = f.read()
    todo = list(dict.fromkeys(x for x in slots if x not in streams))
    jobs = [(kind, config, traffic, s, f, shape) for i, s in todo
            for f, shape in enumerate(picture_shapes(traffic, i, s, kinds))]
    if jobs:
        from pool import run_pool
        nals = run_pool(("clips", "picture_of"), jobs, workers)
        for j, (i, s) in enumerate(todo):
            part = nals[j * len(pocs):(j + 1) * len(pocs)]
            streams[i, s] = b.headers(config, traffic, s) + b"".join(part)
    clips = []
    for (i, s), path in zip(slots, paths):
        stream = streams[i, s]
        if path is not None and not os.path.exists(path + ".json"):
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path + ".266", "wb") as f:
                f.write(stream)
            # the JSON goes last: its presence marks a whole entry
            with open(path + ".json", "w") as f:
                json.dump({"pocs": pocs}, f)
        aus = access_units(stream)
        if len(aus) != len(pocs):
            raise ValueError(f"{kind} clip of seed {s}: {len(aus)} access "
                             f"units for {len(pocs)} pictures")
        clips.append(Clip(stream=stream, aus=aus, pocs=list(pocs), seed=s))
    return clips
