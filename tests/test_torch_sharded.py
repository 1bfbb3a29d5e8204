"""The port's sharded scan (K15a/b, ``merpcr_tpu_torch.parallel.sharded``)
against the JAX package's mesh path, in one process.

* ``shard_planes`` / ``shard_stream_planes`` equal the JAX functions array
  for array (``padded_shards``, ``tile_start0``, ``total_scan``,
  ``tiles_per_shard``) at 1, 2, 3 and 8 shards, on packed and raw planes,
  with the port's group of 1 and the JAX engine's, and on a record shorter
  than one tile;
* per global tile, the port's ``sharded_scan_record`` on ``("cpu",) * 3``
  equals JAX's ``sharded_scan_record`` on three of the eight virtual CPU
  devices read through ``MerPCR._fetch_sharded``: all five totals and every
  hit row, padding tiles included (a record of 4 tiles: the third shard
  owns only padding), at -N 0 (strict, the dirty-span filter armed) and
  -N 2 (loose); then a stream plane at -I 1 through
  ``sharded_scan_stream``. Both packages scan the identical table;
* whole searches under ``use_mesh(make_mesh(("cpu",) * n))``, n = 2, 3, 8,
  equal the port's one-device bytes, JAX's plain bytes and JAX's
  ``use_mesh`` bytes: a record with amplicons at tile and shard
  boundaries, a scaffold assembly at -I 1 (the stream path), an RNA record
  at -N 1 (the raw path), a mesh with more shards than tiles, and the
  golden pair (exactly the golden line). JAX's mesh runs at one shard
  count per corpus (8, 3, 2, 8: it compiles a program per count, and
  ``tests/test_sharding.py`` holds its mesh bytes to its plain bytes); on
  the assembly JAX runs with the mesh only.

The JAX side runs its device path (``MERPCR_TPU_HOST_MAX=0``); the port
runs the plain versions of its kernels (CPU tensors). Everything compared
is an integer or a byte: tolerance 0.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import merpcr_tpu.ops.scan as jscan  # noqa: E402
from merpcr_tpu import MerPCR as JaxMerPCR  # noqa: E402
from merpcr_tpu.parallel import sharded as jsharded  # noqa: E402
from merpcr_tpu_torch import MerPCR  # noqa: E402
from merpcr_tpu_torch.io.fasta import record_packed, record_seq_bytes  # noqa: E402
from merpcr_tpu_torch.ops.table import table_from_numpy  # noqa: E402
from merpcr_tpu_torch.parallel import make_mesh  # noqa: E402
from merpcr_tpu_torch.parallel import sharded as tsharded  # noqa: E402

from .conftest import GOLDEN_FA, GOLDEN_LINE, GOLDEN_STS, run_search  # noqa: E402
from .test_torch_raw import _records, _rna_corpus  # noqa: E402
from .test_torch_stream import (  # noqa: E402
    _padded_rmeta,
    scaffold_lengths,
    write_corpus,
)

P1 = "GGCTCAGAGTATTTGGGATG"
P2 = "CTCTTGGAATCCTATCTCACTG"
TILE = 2048
SHARDS = (2, 3, 8)


@pytest.fixture(autouse=True)
def _jax_device_path(monkeypatch):
    monkeypatch.setenv("MERPCR_TPU_HOST_MAX", "0")


def _genome_with_boundary_hits(n, tile, seed=5):
    """A copy of ``tests/test_sharding.py``'s genome: random ACGT with one
    200-base S1 amplicon planted at tile and shard boundaries."""
    rng = np.random.default_rng(seed)
    g = list("".join(rng.choice(list("ACGT"), size=n)))
    amp = list("".join(rng.choice(list("ACGT"), size=200)))
    amp[: len(P1)] = P1
    amp[200 - len(P2) :] = P2
    amp = "".join(amp)
    for s in [0, tile - 1, tile, 2 * tile - 100, 4 * tile + 1, n - 200]:
        s = min(s, n - 200)
        g[s : s + 200] = amp
    return "".join(g)


# ------------------------------------------------------------ shard planes
def _configs(tmp_path, packed: bool, tile_len: int):
    """Both packages' configs of one STS set at ``tile_len``."""
    sts, _ = write_corpus(tmp_path, 71, [3_000], n_sts=20)
    jeng, eng = JaxMerPCR(), MerPCR(device="cpu")
    assert jeng.load_sts_file(sts) and eng.load_sts_file(sts)
    jcfg = jeng._base_config(tile_len, packed=packed)
    cfg = eng._base_config(tile_len, packed=packed)
    assert (cfg.lead, cfg.tail, cfg.tile_len, cfg.packed) == \
        (jcfg.lead, jcfg.tail, jcfg.tile_len, jcfg.packed)
    return jeng, jcfg, cfg


def _assert_planes_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
        assert np.asarray(g).dtype == np.asarray(w).dtype


@pytest.mark.parametrize("n_shards", [1, 2, 3, 8])
@pytest.mark.parametrize("kind", ["packed", "packed_from_seq", "raw", "short"])
def test_shard_planes_equal_jax(tmp_path, kind, n_shards):
    rng = np.random.default_rng(n_shards)
    n = 700 if kind == "short" else 13_000
    seq = rng.choice(np.frombuffer(b"ACGTN", dtype=np.uint8), size=n,
                     p=[0.24, 0.24, 0.24, 0.24, 0.04])
    packed = kind != "raw"
    if not packed:
        seq[::97] = ord("U")
    jeng, jcfg, cfg = _configs(tmp_path, packed, TILE)
    packed_rec = None
    if kind in ("packed", "short"):
        from merpcr_tpu_torch.models import FASTARecord

        packed_rec = record_packed(FASTARecord(defline=">r", sequence=seq.tobytes().decode()))
    for group in (1, jeng._tile_group(jcfg)):
        want = jsharded.shard_planes(jcfg, seq, 11, n_shards, packed_rec, group=group)
        got = tsharded.shard_planes(cfg, seq, 11, n_shards, packed_rec, group=group)
        _assert_planes_equal(got, want)
        tps = got[3]
        assert tps % group == 0 and n_shards * tps * TILE >= got[2]
        if kind == "short":
            assert got[2] < TILE


@pytest.mark.parametrize("n_shards", [1, 2, 3, 8])
def test_shard_stream_planes_equal_jax(tmp_path, n_shards):
    sts, fa = write_corpus(tmp_path, 72, scaffold_lengths(72, 12), n_sts=20)
    jeng, eng = JaxMerPCR(), MerPCR(device="cpu")
    assert jeng.load_sts_file(sts) and eng.load_sts_file(sts)
    eng._tile_len_override = TILE
    (kind, _, items), = eng._plan(eng.load_fasta_file(fa))
    assert kind == "stream"
    cfg, plane, total_scan, _, _, _ = eng._stream_plane(items)
    jcfg = jeng._base_config(TILE, packed=True, stream=True)
    assert (cfg.lead, cfg.tail) == (jcfg.lead, jcfg.tail)
    for group in (1, jeng._tile_group(jcfg)):
        want = jsharded.shard_stream_planes(jcfg, plane, total_scan, n_shards, group=group)
        got = tsharded.shard_stream_planes(cfg, plane, total_scan, n_shards, group=group)
        _assert_planes_equal(got, want)


# ------------------------------------------------------------ per global tile
def _assert_tiles_equal(outs, j, n_global: int, what: str):
    """The port's ScanOuts against JAX's ``_fetch_sharded`` arrays, per
    global tile."""
    assert len(outs) == n_global, what

    def col(name):
        return np.asarray(getattr(j, name)).reshape(n_global, -1)

    totals = np.stack([col(k)[:, 0] for k in
                       ("c_total", "pos_total", "pair_total", "anch_total", "hit_total")], 1)
    for i, o in enumerate(outs):
        assert tuple(o[:5]) == tuple(int(v) for v in totals[i]), (what, i)
        for name in ("pos1", "pos2", "entry", "pair_order", "rank", "rec"):
            np.testing.assert_array_equal(getattr(o, name).numpy(),
                                          col(name)[i, : o.hit_total],
                                          err_msg=f"{what} tile {i} {name}")


def _caps(cfg, tile_len: int):
    return jscan.ScanConfig(**{**cfg.__dict__, "cpos_cap": tile_len // cfg.front_stride,
                               "pos_cap": tile_len, "cand_cap": 8192,
                               "anch_cap": 1024, "hit_cap": 4096})


_RECORD: list = []


def _record_case(tmp_path_factory):
    """A dirty 8,000-base record (4 tiles of 2048: on 3 shards of 2 tiles
    the third owns only padding) with both engines on its STS set."""
    if not _RECORD:
        tmp = tmp_path_factory.mktemp("shard_rec")
        sts, fa = write_corpus(tmp, 73, [8_000], n_sts=40, dirty=0.01)
        jeng = JaxMerPCR()
        eng = MerPCR(device="cpu")
        assert jeng.load_sts_file(sts) and eng.load_sts_file(sts)
        rec = eng.load_fasta_file(fa)[0]
        _RECORD.append((jeng, eng, record_seq_bytes(rec), record_packed(rec)))
    return _RECORD[0]


@pytest.mark.parametrize("mismatches", [0, 2])
def test_sharded_record_tiles_equal_jax(tmp_path_factory, mismatches):
    jeng, eng, seq, packed = _record_case(tmp_path_factory)
    jeng.mismatches = eng.mismatches = mismatches
    dirty = jeng._dirty_of(seq, packed)
    jcfg = _caps(jeng._base_config(TILE, packed=True, dirty=jeng._quantize_dirty(dirty[0]),
                                   dirty_pos=jeng._quantize_dirty(dirty[1])), TILE)
    cfg = eng._base_config(TILE, packed=True,
                           dirty_pos=eng._quantize_dirty(eng._dirty_of(seq, packed)[1]))
    assert (cfg.strict, cfg.dirty_bloom) == (jcfg.strict, jcfg.dirty_bloom) \
        == ((True, True) if mismatches == 0 else (False, False))
    table = table_from_numpy(jeng._table_host, jeng._meta, "cpu")
    rt = np.asarray([50, mismatches, 1], dtype=np.int32)
    jmesh = jsharded.make_mesh(jax.devices()[:3])
    souts, ns, tps, G, gathered = jsharded.sharded_scan_record(
        jcfg, jeng._table, seq, 11, jmesh, rt=rt, packed_rec=packed, group=1)
    j = JaxMerPCR._fetch_sharded(souts, ns, tps, G, gathered)
    outs = tsharded.sharded_scan_record(cfg, table, seq, 11, make_mesh(("cpu",) * 3),
                                        tuple(rt), packed_rec=packed)
    assert (ns, tps) == (3, 2)
    _assert_tiles_equal(outs, j, ns * tps, f"record -N {mismatches}")
    assert [o.c_total for o in outs[4:]] == [0, 0]  # the padding shard
    assert sum(o.hit_total for o in outs) > 0


def test_sharded_stream_tiles_equal_jax(tmp_path):
    sts, fa = write_corpus(tmp_path, 75, scaffold_lengths(75, 12), n_sts=30, dirty=0.004,
                           ambiguous_sts=True)
    jeng, eng = JaxMerPCR(iupac_mode=1), MerPCR(device="cpu", iupac_mode=1)
    assert jeng.load_sts_file(sts) and eng.load_sts_file(sts)
    eng._tile_len_override = TILE
    (kind, _, items), = eng._plan(eng.load_fasta_file(fa))
    assert kind == "stream"
    cfg, plane, total_scan, stream_len, rmeta, recmap = eng._stream_plane(items)
    # the length-weighted dirty rates of both engines (``_stream_plane``)
    n = np.asarray([len(seq) for seq, _ in items], dtype=float)
    dirty = [float((np.asarray(col) * n).sum() / n.sum())
             for col in zip(*(jeng._dirty_of(seq, p) for seq, p in items))]
    jcfg = _caps(jeng._base_config(TILE, packed=True, stream=True,
                                   dirty=jeng._quantize_dirty(dirty[0]),
                                   dirty_pos=jeng._quantize_dirty(dirty[1])), TILE)
    assert cfg.iupac and cfg.stream and cfg.dirty_bloom
    assert (cfg.dirty_bloom, cfg.lead, cfg.tail) == (jcfg.dirty_bloom, jcfg.lead, jcfg.tail)
    jtable, ttable = jeng._table, table_from_numpy(jeng._table_host, jeng._meta, "cpu")
    rt = np.asarray([50, 0, 1], dtype=np.int32)
    jmesh = jsharded.make_mesh(jax.devices()[:3])
    souts, ns, tps, G, gathered = jsharded.sharded_scan_stream(
        jcfg, jtable, plane, _padded_rmeta(rmeta), total_scan, stream_len, jmesh,
        rt=rt, recmap=recmap, group=1)
    j = JaxMerPCR._fetch_sharded(souts, ns, tps, G, gathered)
    outs = tsharded.sharded_scan_stream(cfg, ttable, plane, rmeta, total_scan, stream_len,
                                        make_mesh(("cpu",) * 3), tuple(rt), recmap=recmap)
    n_tiles = -(-total_scan // cfg.tile_len)
    assert ns * tps >= n_tiles >= 7
    _assert_tiles_equal(outs, j, ns * tps, "stream -I 1")
    assert len({int(r) for o in outs for r in o.rec}) >= 3


def test_replicated_table_is_copied_once_per_device(tmp_path_factory):
    _, eng, seq, packed = _record_case(tmp_path_factory)
    eng.mismatches = 0
    tables = {}
    cfg = eng._base_config(TILE, packed=True)
    mesh = make_mesh(("cpu",) * 3)
    for _ in range(2):
        tsharded.sharded_scan_record(cfg, eng._table, seq, 11, mesh, (50, 0, 1),
                                     packed_rec=packed, tables=tables)
    assert list(tables) == [torch.device("cpu")]


# ------------------------------------------------------------ whole searches
def _search(pkg: str, sts: str, recs, tile_len, n_shards=None, **params) -> tuple:
    """(output, engine) of one fresh engine; ``recs`` a FASTA path or a
    (label, sequence) list; ``n_shards`` None: no mesh."""
    if pkg == "torch":
        eng = MerPCR(device="cpu", **params)
        if n_shards:
            eng.use_mesh(make_mesh(("cpu",) * n_shards))
    else:
        eng = JaxMerPCR(**params)
        if n_shards:
            eng.use_mesh(jsharded.make_mesh(jax.devices()[:n_shards]))
    eng._tile_len_override = tile_len
    assert eng.load_sts_file(sts)
    records = eng.load_fasta_file(recs) if isinstance(recs, str) else _records(pkg, recs)
    return run_search(eng, records), eng


def _assert_every_mesh_equal(sts, recs, tile_len, jax_shards, shards=SHARDS,
                             **params) -> str:
    """The port's bytes at every shard count of ``shards`` equal its
    one-device bytes and JAX's at every entry of ``jax_shards`` (None:
    JAX without a mesh)."""
    want, _ = _search("torch", sts, recs, tile_len, **params)
    for n in jax_shards:
        assert _search("jax", sts, recs, tile_len, n, **params)[0] == want, n
    for n in shards:
        got, eng = _search("torch", sts, recs, tile_len, n, **params)
        assert got == want, n
        assert {s.shards for s in eng.last_scans} == {n}
    return want


def test_boundary_record_any_shard_count(tmp_path):
    g = _genome_with_boundary_hits(8 * TILE + 531, TILE)
    sts = tmp_path / "s.sts"
    sts.write_text(f"S1\t{P1}\t{P2}\t200\tAL\n")
    fa = tmp_path / "g.fa"
    fa.write_text(f">g\n{g}\n")
    out = _assert_every_mesh_equal(str(sts), str(fa), TILE, (None, 8))
    assert out.count("\n") >= 5


def test_scaffold_assembly_any_shard_count(tmp_path):
    """JAX with a mesh only: the port's one-device bytes on scaffold
    assemblies are held to JAX's plain bytes in ``test_torch_stream.py``
    (a JAX stream program takes ~5 s to compile here)."""
    sts, fa = write_corpus(tmp_path, 74, scaffold_lengths(74, 8), n_sts=30, dirty=0.004,
                           ambiguous_sts=True)
    out = _assert_every_mesh_equal(sts, fa, TILE, (3,), iupac_mode=1)
    assert len({line.split("\t")[0] for line in out.splitlines()}) >= 3


def test_rna_record_any_shard_count(tmp_path):
    sts, _, rna = _rna_corpus()
    path = tmp_path / "s.sts"
    path.write_text(sts)
    out = _assert_every_mesh_equal(str(path), [("r", rna)], TILE, (None, 2), iupac_mode=1,
                                   mismatches=1)
    assert out.count("\n") > 5


def test_more_shards_than_tiles(tmp_path):
    """3 tiles on 8 shards (the boundary record's STS set and tile: the JAX
    programs of that test serve this one)."""
    g = _genome_with_boundary_hits(3 * TILE + 17, TILE, seed=6)
    sts = tmp_path / "s.sts"
    sts.write_text(f"S1\t{P1}\t{P2}\t200\tAL\n")
    fa = tmp_path / "g.fa"
    fa.write_text(f">g\n{g}\n")
    out = _assert_every_mesh_equal(str(sts), str(fa), TILE, (None, 8), shards=(8,))
    assert out.count("\n") >= 3


@pytest.mark.parametrize("n_shards", SHARDS)
def test_golden_sharded(n_shards):
    out, eng = _search("torch", GOLDEN_STS, GOLDEN_FA, 1 << 15, n_shards)
    assert out == GOLDEN_LINE + "\n"
    (scan,) = eng.last_scans
    assert scan.shards == n_shards and scan.tiles >= 2
