"""``"loop": "warm_engine"``: one warm engine in a closed loop with one
client. Set-up writes the inputs as STS and FASTA files, loads them into a
fresh ``MerPCR``, runs its first search and every setting once more; the
window then searches the records over and over, each search with the next
settings of the traffic mix, its lines into memory in place of
``sys.stdout``. A traced run profiles a segment of searches after the
window."""

from __future__ import annotations

import gc
import tempfile
import time

from pcr_bench import generate, harness


def drive(ctx) -> list:
    """The cell's searches as (setting index, text), the program's state
    freed; fills ``ctx.run``."""
    run, cfg, inp = ctx.run, ctx.cell.config, ctx.inp
    settings, steps = inp.searches, run.steps
    from merpcr_tpu_torch import MerPCR

    eng = MerPCR(wordsize=cfg["wordsize"], margin=settings[0]["margin"],
                 mismatches=settings[0]["mismatches"],
                 three_prime_match=cfg["three_prime_match"], iupac_mode=cfg["iupac_mode"],
                 device=ctx.device)
    with tempfile.TemporaryDirectory(prefix="pcr_bench_") as tmp:
        t0 = time.perf_counter()
        sts, fa = generate.write_inputs(tmp, inp)
        steps["write_inputs"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        if not eng.load_sts_file(sts):
            raise RuntimeError("the STS file did not load")
        run.setup_spans["sts_compile_s"] = steps["sts_compile"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        recs = eng.load_fasta_file(fa)
        steps["load_fasta"] = time.perf_counter() - t0
    bases = sum(len(r.sequence) for r in recs)
    if bases != inp.bases or len(recs) != len(inp.labels):
        raise RuntimeError(f"loaded {len(recs)} records of {bases} bases, made "
                           f"{len(inp.labels)} of {inp.bases}")
    # the fresh engine's first search, then every setting once more
    first = harness.search(eng, recs, 0, settings, bases)
    run.setup_spans["first_search_s"] = steps["first_search"] = first.ms / 1e3
    warm = [harness.search(eng, recs, i % len(settings), settings, bases)
            for i in range(1, len(settings) + 1)]
    steps["warm_up"] = sum(w.ms for w in warm) / 1e3
    # which scan paths the settings take (front end, stream, K10, K11), and
    # the record tiles' length, where boundary plants belong
    run.info["scan_paths"] = sorted(
        {(f"strict{p.cfg.strict_n}" if p.cfg.strict else "loose")
         + ("+stream" if p.cfg.stream else "") + ("+dirty" if p.cfg.dirty_bloom else "")
         + ("+iupac" if p.cfg.iupac else "") for p in eng.last_scans})
    run.info["record_tile_len"] = sorted({p.cfg.tile_len for p in eng.last_scans
                                          if not p.cfg.stream})
    probe = harness.Probe(eng) if ctx.trace else None
    if ctx.profile:
        from pcr_bench import trace as profiler

        profiler.warm()
    ctx.sync()
    run.setup_s = time.perf_counter() - ctx.t0
    nxt = harness.window(run, eng, recs, settings, bases, len(settings) + 1, probe)
    if ctx.profile:
        harness.segment(run, eng, recs, settings, bases, nxt, probe,
                        int(ctx.cell.traffic["trace_searches"]))
    ctx.sync()
    run.peak_bytes = ctx.peak_bytes()
    outputs = [(s.setting, s.text) for s in [first, *warm, *run.window, *run.segment]]
    # free the program's state before the reference runs
    from merpcr_tpu_torch import engine

    if probe is not None:
        probe.close()
    del eng, recs, probe, first, warm
    engine._OWNERS.clear()
    gc.collect()
    ctx.empty_cache()
    return outputs
