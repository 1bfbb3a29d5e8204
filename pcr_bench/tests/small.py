"""A small copy of the benchmark for CPU tests: the real BENCHMARK.json's
metrics and the real readers, with configurations and traffic mixes cut to a
size the CPU scans in seconds, under a checkout root of its own."""

from __future__ import annotations

import json
import os
import shutil

from pcr_bench import spec

CHR = {
    "name": "chr_small", "source": "test", "records": [["chr1", 1_000_000]],
    "sts_count": 400, "primer_len": [18, 25], "product_len": [100, 399],
    "wordsize": 11, "margin": 50, "mismatches": 0,
    "three_prime_match": 1, "iupac_mode": 0, "reduced": [],
}
# scaffolds of 1-38 kbp, 500 kbp in all: one stream run of the program
SCAFFOLDS = [1000 + (i * 7919) % 37000 for i in range(26)]
SCAFFOLDS[-1] += 500_000 - sum(SCAFFOLDS)
ASM = {
    **CHR, "name": "asm_small", "records": [[f"scaf{i}", n] for i, n in enumerate(SCAFFOLDS)],
    "ambiguity_rate": 0.01, "ambiguity_letters": "NRYKMSWBDHV",
    "degenerate_every": 4, "degenerate_letters": "RYN", "degenerate_per_primer": 2,
    "iupac_mode": 1,
}
TRAFFIC = {
    "sparse": {"loop": "warm_engine", "searches": [{"mismatches": 1}],
               "plants": {"exact": 20, "boundary": {"every": 1 << 17},
                          "mismatch": {"1": 5, "2": 5},
                          "off_size": {"deltas": [100, -100, 700], "per_delta": 2}},
               "control": {"mismatches": 0}, "trace_searches": 2},
    "msweep": {"loop": "warm_engine", "searches": [{"margin": m} for m in (50, 70, 100)],
               "plants": {"exact": 40, "off_size": {"deltas": [55, -65, 95], "per_delta": 2}},
               "control": {"iupac_mode": 0}, "trace_searches": 3},
    "dense": {"loop": "warm_engine", "searches": [{"mismatches": 1}],
              "plants": {"exact": 20, "all_sts": {"mismatch_every": 10}},
              "control": {"mismatches": 0}, "trace_searches": 2},
}
CELLS = {"chr_small.sparse": ("chr_small", "sparse"), "asm_small.msweep": ("asm_small", "msweep"),
         "chr_small.dense": ("chr_small", "dense")}
REPO = os.path.dirname(spec.BENCH_DIR)


def make_root(tmp: str) -> str:
    """A checkout root under ``tmp`` holding the small benchmark."""
    with open(os.path.join(REPO, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    bench_dir = os.path.join(tmp, "pcr_bench")
    for kind in ("metrics", "plants", "loops"):
        shutil.copytree(os.path.join(spec.BENCH_DIR, kind), os.path.join(bench_dir, kind))
    os.makedirs(os.path.join(bench_dir, "configs"))
    os.makedirs(os.path.join(bench_dir, "traffic"))
    bench["configs"] = []
    for cfg in (CHR, ASM):
        path = f"pcr_bench/configs/{cfg['name']}.json"
        write(os.path.join(tmp, path), cfg)
        bench["configs"].append({"name": cfg["name"], "source": "test", "file": path,
                                 "reduced": [], "why": "test"})
    for name, traffic in TRAFFIC.items():
        write(os.path.join(bench_dir, "traffic", f"{name}.json"), traffic)
    bench["workloads"] = [{"name": c, "config": cfg, "traffic": t, "chips": 1, "why": "test"}
                          for c, (cfg, t) in CELLS.items()]
    write(os.path.join(tmp, "BENCHMARK.json"), bench)
    return tmp


def write(path: str, obj) -> None:
    with open(path, "w") as fh:
        json.dump(obj, fh)
