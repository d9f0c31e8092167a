"""What `correct` rests on: the plain reference decode and the comparison.

The reference is refdec, a frozen copy of the port's host plane in
Python and NumPy (no C) that imports nothing of the program.  It decodes
every distinct clip of a run once, after the window, from the clip's
bytes alone.  A clip is cut at its IDR pictures into segments that
decode on their own (each led by the parameter sets the stream has sent
before it), and the segments run in a pool of worker processes.  Per
picture it keeps the planes, their MD5 and the kernels' work
(work.picture_work).  The MD5s and the work are cached under the cache
directory by the clip's bytes and the reference's sources; on a cache
hit the comparison is by MD5, and a picture whose MD5 differs is decoded
again for its samples.

The comparison takes every picture the program handed out in the
window, with its clip and POC, and holds it sample for sample to the
reference's picture of that POC: every sample of Y, Cb and Cr.  A clip
whose first k access units were fed must hand out exactly the pictures
of those k POCs, each once.  Its numbers, each with the limit 0:
`pictures_missing` (fed, never handed out, handed out twice or not
fed), `pictures_differing` and `max_abs_diff` (over every sample).
"""

from __future__ import annotations

import hashlib
import json
import os
from dataclasses import dataclass, field

import numpy as np

from pool import run_pool

HERE = os.path.dirname(os.path.abspath(__file__))
LIMITS = {"pictures_missing": 0, "pictures_differing": 0, "max_abs_diff": 0}


def planes_md5(planes) -> str:
    h = hashlib.md5()
    for p in planes:
        h.update(np.ascontiguousarray(p, dtype="<u2").tobytes())
    return h.hexdigest()


def segments(stream: bytes) -> list:
    """The stream cut before each IDR picture into pieces that decode on
    their own: each piece is led by every parameter set (VPS, SPS, PPS,
    APS) the stream sent before it, in the stream's order."""
    from refdec.bitstream.nal import (NalUnitType, is_idr, is_vcl,
                                      split_annexb)
    ps_types = {NalUnitType.VPS, NalUnitType.SPS, NalUnitType.PPS,
                NalUnitType.PREFIX_APS, NalUnitType.SUFFIX_APS,
                NalUnitType.DCI}
    nals = split_annexb(stream)
    starts = [0] + [off - 4 if stream[off - 4] == 0 else off - 3
                    for off, _ in nals[1:]]
    ends = starts[1:] + [len(stream)]
    pieces, sent_ps, cur, cur_has_vcl = [], b"", b"", False
    for (off, _), a, b in zip(nals, starts, ends):
        t = stream[off + 1] >> 3
        raw = stream[a:b]
        if is_idr(t) and cur_has_vcl:
            pieces.append(cur)
            cur, cur_has_vcl = sent_ps, False
        if t in ps_types:
            sent_ps += raw
        cur += raw
        if is_vcl(t):
            cur_has_vcl = True
    if cur_has_vcl:
        pieces.append(cur)
    return pieces


def decode_piece(piece: bytes) -> list:
    """[(poc, planes, work)] of one piece, in output order."""
    from refdec.decoder import decode_annexb
    from work import picture_work
    works = {}

    def on_picture(poc, cs):
        works[poc] = picture_work(cs)

    pics = decode_annexb(piece, on_picture=on_picture)
    return [(p.poc, [np.ascontiguousarray(x, dtype=np.uint16)
                     for x in p.planes], works[p.poc]) for p in pics]


@dataclass
class RefClip:
    """The reference's pictures of one clip, by POC."""

    md5: dict = field(default_factory=dict)     # poc -> MD5
    work: dict = field(default_factory=dict)    # poc -> picture_work
    planes: dict = field(default_factory=dict)  # poc -> planes, if decoded


def _sources_digest() -> str:
    h = hashlib.sha256()
    paths = [os.path.join(HERE, "work.py"), os.path.join(HERE, "reference.py")]
    for root, _, files in os.walk(os.path.join(HERE, "refdec")):
        paths += [os.path.join(root, f) for f in files
                  if f.endswith((".py", ".npz"))]
    for p in sorted(paths):
        with open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def decode_clips(streams: list, workers: int) -> list:
    """RefClip of each stream, its pieces decoded in a pool of `workers`
    processes (pool.py)."""
    tasks = [(i, piece) for i, s in enumerate(streams)
             for piece in segments(s)]
    out = [RefClip() for _ in streams]
    results = run_pool(("reference", "decode_piece"), [p for _, p in tasks],
                       workers)
    for (i, _), pics in zip(tasks, results):
        for poc, planes, wk in pics:
            if poc in out[i].md5:
                raise ValueError(f"the reference gave POC {poc} twice")
            out[i].md5[poc] = planes_md5(planes)
            out[i].work[poc] = wk
            out[i].planes[poc] = planes
    return out


def reference(clips: list, cache_dir: str | None, workers: int) -> list:
    """RefClip of each clip: from the cache, or decoded and cached."""
    digest = _sources_digest()
    out: list = [None] * len(clips)
    todo = []
    for i, c in enumerate(clips):
        path = None if cache_dir is None else os.path.join(
            cache_dir, "ref", f"{c.key}_{digest}.json")
        if path is not None and os.path.exists(path):
            with open(path) as f:
                d = json.load(f)
            out[i] = RefClip(md5={int(k): v for k, v in d["md5"].items()},
                             work={int(k): v for k, v in d["work"].items()})
        else:
            todo.append((i, path))
    if todo:
        done = decode_clips([clips[i].stream for i, _ in todo], workers)
        for (i, path), rc in zip(todo, done):
            out[i] = rc
            if path is not None:
                os.makedirs(os.path.dirname(path), exist_ok=True)
                tmp = path + ".part"
                with open(tmp, "w") as f:
                    json.dump({"md5": rc.md5, "work": rc.work}, f)
                os.replace(tmp, path)
    return out


def compare(handed: list, fed: list, clips: list, refs: list,
            workers: int = 1) -> dict:
    """The comparison's numbers.  handed: (clip index, poc, planes) of
    every picture handed out; fed: (clip index, k) of every clip decode,
    k its access units fed.  A picture whose MD5 differs from a cached
    reference's has its clip decoded again for its samples."""
    expected: dict = {}
    for ci, k in fed:
        for poc in clips[ci].pocs[:k]:
            expected[(ci, poc)] = expected.get((ci, poc), 0) + 1
    got: dict = {}
    for ci, poc, _ in handed:
        got[(ci, poc)] = got.get((ci, poc), 0) + 1
    missing = sum(abs(expected.get(k, 0) - got.get(k, 0))
                  for k in set(expected) | set(got))
    differing = []
    md5s: dict = {}     # a copy that several pictures share: hashed once
    for ci, poc, planes in handed:
        want = refs[ci].md5.get(poc)
        if id(planes) not in md5s:
            md5s[id(planes)] = planes_md5(planes)
        if want is None or md5s[id(planes)] != want:
            differing.append((ci, poc, planes))
    max_abs = 0
    need = sorted({ci for ci, poc, _ in differing
                   if poc in refs[ci].md5 and poc not in refs[ci].planes})
    if need:
        again = decode_clips([clips[ci].stream for ci in need], workers)
        for ci, rc in zip(need, again):
            refs[ci].planes.update(rc.planes)
    for ci, poc, planes in differing:
        ref = refs[ci].planes.get(poc)
        if ref is None:
            continue    # not a picture of the clip: counted as missing
        for p, r in zip(planes, ref):
            if p.shape != r.shape:
                max_abs = max(max_abs, 1 << 16)
                continue
            d = np.abs(p.astype(np.int32) - r.astype(np.int32))
            max_abs = max(max_abs, int(d.max()))
    return {"pictures_missing": missing,
            "pictures_differing": len(differing),
            "max_abs_diff": max_abs}


def is_correct(numbers: dict) -> bool:
    return all(numbers[k] <= lim for k, lim in LIMITS.items())
