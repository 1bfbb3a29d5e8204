#!/usr/bin/env python3
"""Card check of the PyTorch/CUDA port (``merpcr_tpu_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py [--seed 0] [--mbp 47] [--nsts 1000] [--planted 200]

Phases (each prints one JSON line; any failure exits non-zero, and the
closing device line is printed only when every phase passed):

1. device    card name, and name + power limit from nvidia-smi
2. build     the four kernels compiled from csrc/ by nvcc for sm_90a, one
             process per source, all at once; ptxas register/smem lines
3. workload  a random ACGT genome (one record) and random STS made from
             --seed, the first --planted STS planted as amplicons, plus
             one amplicon across every 2^23 tile boundary and one anchor
             W-mer straddling each boundary; written as STS + FASTA files
4. kernels   on one real 2^23 tile of that genome, each kernel against
             its plain PyTorch version on the same card tensors: every
             output and total must be equal (integers, tolerance 0); times
             from CUDA events
5. end2end   MerPCR().load_sts_file -> load_fasta_file -> search on the
             card, cold then warm (launch counts read around the warm
             run); every planted amplicon's line present; output bytes
             equal to the same search with device="cpu" (plain versions);
             then a breakdown of one record's search: host-clock time per
             step and device time per kernel from torch.profiler
6. golden    tests/data through the API and through
             ``python -m merpcr_tpu_torch``: exactly the golden line

The second-to-last JSON line lists every kernel with its launches on the
main path, error against its plain version, times and byte bound; the
line before the last is nvidia-smi's name and power limit; the last line
is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import subprocess
import sys
import tempfile
import time
from contextlib import redirect_stdout

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
SCALAR_OPS_PER_S = 67e12  # H100 SXM non-tensor 32-bit peak (fp32 table entry)
TILE = 1 << 23
GOLDEN_LINE = "L78833\t75823..76023\tAFM248yg9\t(D17S932)  Chr.17, 63.7 cM\t(-)"
ROOT = os.path.dirname(os.path.abspath(__file__))


def check(cond, msg: str) -> None:
    """Fail the run (exit non-zero, no result line) unless ``cond``."""
    if not cond:
        raise RuntimeError(msg)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- workload
def make_workload(tmp: str, seed: int, n_mbp: float, n_sts: int, planted: int):
    """(sts path, fasta path, genome length, expected planted lines)."""
    rng = np.random.default_rng(seed)
    n = int(n_mbp * 1e6)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    genome = acgt[rng.integers(0, 4, size=n, dtype=np.uint8)]
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    rows = []
    for i in range(n_sts):
        p1 = acgt[rng.integers(0, 4, size=int(rng.integers(18, 26)))].tobytes()
        p2 = acgt[rng.integers(0, 4, size=int(rng.integers(18, 26)))].tobytes()
        rows.append((f"SMOKE{i}", p1, p2, int(rng.integers(100, 400))))
    label = "smoke_genome"
    expect, taken = [], []

    def plant(pos, i, strand):
        sid, p1, p2, size = rows[i]
        if pos < 0 or pos + size > n or any(a < pos + size and pos < b for a, b in taken):
            return
        left, right = (p1, p2) if strand == "+" else (p2, p1.translate(comp)[::-1])
        genome[pos : pos + len(left)] = np.frombuffer(left, dtype=np.uint8)
        genome[pos + size - len(right) : pos + size] = np.frombuffer(right, dtype=np.uint8)
        taken.append((pos, pos + size))
        expect.append(f"{label}\t{pos + 1}..{pos + size}\t{sid}\talias {sid}\t({strand})")

    for i in range(planted):  # evenly spread, as bench.py plants them
        plant((n // (planted + 1)) * (i + 1), i, "+")
    k = planted
    for b in range(TILE, n, TILE):
        plant(b - 60, k % n_sts, "+")  # amplicon across the tile boundary
        plant(b - 7, (k + 1) % n_sts, "-")  # anchor W-mer straddles it
        k += 2
    sts = os.path.join(tmp, "smoke.sts")
    with open(sts, "w") as fh:
        for sid, p1, p2, size in rows:
            fh.write(f"{sid}\t{p1.decode()}\t{p2.decode()}\t{size}\talias {sid}\n")
    fa = os.path.join(tmp, "smoke.fa")
    width = 80
    pad = (-n) % width
    body = np.concatenate([genome, np.full(pad, ord("\n"), np.uint8)]).reshape(-1, width)
    body = np.concatenate([body, np.full((len(body), 1), ord("\n"), np.uint8)], axis=1)
    with open(fa, "wb") as fh:
        fh.write(f">{label} synthetic {n} bp\n".encode())
        fh.write(body.tobytes()[: n + -(-n // width)])  # ends in a newline
    return sts, fa, n, expect


# ---------------------------------------------------------------- timing
def cuda_ms(fn, reps: int) -> float:
    fn()  # warm up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_time(fn) -> dict:
    """{name: (device seconds, count)} of the CUDA-side events (kernels,
    copies, fills) that ``fn`` issues, from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {
        e.key: (e.self_device_time_total / 1e6, e.count)
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
    }


def max_abs_err(got, want) -> int:
    """Largest absolute difference over matching outputs (ints and
    tensors); a shape mismatch is a failure."""
    err = 0
    for g, w in zip(got, want):
        if isinstance(g, torch.Tensor):
            if g.shape != w.shape:
                raise RuntimeError(f"shape {tuple(g.shape)} != {tuple(w.shape)}")
            if g.numel():
                err = max(err, int((g.to(torch.int64) - w.to(torch.int64)).abs().max()))
        else:
            err = max(err, abs(int(g) - int(w)))
    return err


def bound(n_bytes: float, n_ops: float) -> tuple:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def search_bytes(engine, recs) -> tuple:
    buf = io.StringIO()
    t0 = time.perf_counter()
    with redirect_stdout(buf):
        hits = engine.search(recs)
    if engine.device.type == "cuda":
        torch.cuda.synchronize()
    return buf.getvalue(), hits, time.perf_counter() - t0


# ---------------------------------------------------------------- phases
def phase_kernels(eng, recs, card: str) -> dict:
    """Each kernel and its plain version on one real 2^23 tile."""
    from merpcr_tpu_torch.io.fasta import record_packed
    from merpcr_tpu_torch.ops.expand import expand, expand_plain
    from merpcr_tpu_torch.ops.front_end import front_end, front_end_plain
    from merpcr_tpu_torch.ops.margin_p2 import margin_p2, margin_p2_plain
    from merpcr_tpu_torch.ops.units import unit_regs, units_of
    from merpcr_tpu_torch.ops.verify_p1 import verify_p1, verify_p1_plain

    rec = recs[0]
    n = len(rec.sequence)
    W = eng.wordsize
    total = n - W + 1
    cfg = eng._base_config(eng._pick_tile_len(total))
    L, lead = cfg.tile_len, cfg.lead
    check(L == TILE, f"tile length {L}")
    n_tiles = -(-total // L)
    plane = torch.from_numpy(
        eng._plane(record_packed(rec), lead + n_tiles * L + cfg.tail, lead)
    ).to(eng.device)
    t = 1  # starts at a tile boundary, holds boundary plants on both sides
    t0 = t * L
    tile = plane[t0 // 2 : t0 // 2 + cfg.tile_buf_in]
    n_scan = min(L, total - t0)
    tb = eng._table
    margin, nmm, x = eng._runtime_params()
    res = {}

    def run(name, kernel, plain, args, reps, n_bytes, n_ops, replaces, out_of):
        got, want = kernel(*args), plain(*args)
        err = max_abs_err(out_of(got), out_of(want))
        ms = cuda_ms(lambda: kernel(*args), reps)
        plain_ms = cuda_ms(lambda: plain(*args), max(2, reps // 5))
        dev = device_time(lambda: [kernel(*args) for _ in range(reps)])
        device_ms = sum(v[0] for v in dev.values()) * 1e3 / reps
        b_ms, b_by = bound(n_bytes, n_ops)
        res[name] = {
            "name": name, "route": "cuda",
            "source": f"merpcr_tpu_torch/csrc/{name}.cu",
            "replaces": replaces, "equal": err == 0, "max_abs_err": err,
            "ms": ms, "kernel_ms": ms, "device_ms": device_ms,
            "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None,
        }
        if err:
            raise RuntimeError(f"{name}: kernel differs from plain by {err}")
        return got

    # K1: plane units of the scan span + the distinct qbloom_s words looked up
    n_units = L // 8
    u = units_of(tile[: tile.numel() // 4 * 4])
    A, _, B, _ = unit_regs(u, torch.arange(n_units, device=tile.device) + lead // 8)
    bk = ((A >> 14) | ((B & 0xFF) << 18)) & ((1 << tb.gq) - 1)
    distinct_words = int(torch.unique(bk >> 5).numel())
    del u, A, B, bk
    fe_args = (tile, tb.qbloom_s, tb.gq, W, lead, L, n_scan)
    words, c_total = run(
        "front_end", front_end, front_end_plain, fe_args, 50,
        4 * (n_units + 2) + 4 * distinct_words + n_units // 8 + 4,
        70 * n_units, "merpcr_tpu/ops/scan.py:452", lambda o: o,
    )
    c_total = int(c_total.item())
    ex_args = (tile, words, tb.ptab, tb.pf_bits, tb.t16, tb.t16_bits, tb.bsc,
               tb.emeta.shape[0], W, lead, L, n_scan)
    first = expand(*ex_args)
    pos_total, pair_total = first[2], first[3]
    entry, ppos, _, _ = run(
        "expand", expand, expand_plain, ex_args, 20,
        n_units // 8 + c_total * (12 + 8) + pos_total * 12 + pair_total * 8,
        4 * n_units + 300 * c_total, "merpcr_tpu/ops/scan.py:680", lambda o: o,
    )
    v_args = (tile, entry, ppos, tb.emeta, tb.p1_codes, t0, n, lead, nmm, x)
    a_idx = run(
        "verify_p1", verify_p1, verify_p1_plain, v_args, 20,
        pair_total * (8 + 32 + 16 + tb.p1_codes.shape[1]),
        pair_total * 6 * tb.p1_codes.shape[1], "merpcr_tpu/ops/scan.py:979",
        lambda o: (o,),
    )
    anch = a_idx.numel()
    m_args = (tile, a_idx, entry, ppos, tb.emeta, tb.p2_codes, t0, n, lead,
              margin, nmm, x)
    rows = run(
        "margin_p2", margin_p2, margin_p2_plain, m_args, 20,
        anch * (4 + 8 + 32 + tb.p2_codes.shape[1] + (2 * margin + cfg.p2_max) // 2),
        anch * (2 * margin + 1) * 40, "merpcr_tpu/ops/scan.py:1047",
        lambda o: (o,),
    )
    emit({"phase": "kernels", "tile": t, "tile_len": L, "card": card,
          "totals": {"c": c_total, "pos": pos_total, "pair": pair_total,
                     "anch": anch, "hit": int(rows.shape[0])},
          "kernels": [{k: r[k] for k in ("name", "equal", "kernel_ms", "device_ms",
                                         "plain_ms", "max_abs_err")}
                      for r in res.values()]})
    return res


def breakdown(eng, recs) -> dict:
    """Host-clock time of each step of one record's search, and device
    time by kernel name from torch.profiler over the tile scan."""
    from merpcr_tpu_torch.io.fasta import record_packed, record_seq_bytes
    from merpcr_tpu_torch.ops.scan import scan_record

    rec = recs[0]
    seq, packed = record_seq_bytes(rec), record_packed(rec)
    n = len(seq)
    total = n - eng.wordsize + 1
    out = {}
    t0 = time.perf_counter()
    eng._dirty_of(seq, packed)
    out["dirty_rate_s"] = time.perf_counter() - t0
    cfg = eng._base_config(eng._pick_tile_len(total))
    n_tiles = -(-total // cfg.tile_len)
    t0 = time.perf_counter()
    plane_np = eng._plane(packed, cfg.lead + n_tiles * cfg.tile_len + cfg.tail, cfg.lead)
    out["plane_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    plane = torch.from_numpy(plane_np).to(eng.device)
    torch.cuda.synchronize()
    out["upload_s"] = time.perf_counter() - t0

    def scan():
        scan_record(cfg, eng._table, plane, 0, total, n, eng._runtime_params(), n_tiles)
        torch.cuda.synchronize()

    t0 = time.perf_counter()
    scan()
    out["scan_tiles_s"] = time.perf_counter() - t0
    dev = device_time(scan)
    busy = sum(v[0] for v in dev.values())
    out["device_busy_s"] = busy if dev else None
    # against the unprofiled scan of the same tiles
    out["device_idle_share"] = (1 - busy / out["scan_tiles_s"]) if dev else None
    out["device_by_name"] = {
        k.replace("(anonymous namespace)::", "").split("(")[0]: {
            "device_s": v[0], "count": v[1]}
        for k, v in dev.items()
    }
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mbp", type=float, default=47.0)
    ap.add_argument("--nsts", type=int, default=1000)
    ap.add_argument("--planted", type=int, default=200)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from merpcr_tpu_torch import MerPCR
    from merpcr_tpu_torch.ops import kernels
    from merpcr_tpu_torch.ops.expand import expand
    from merpcr_tpu_torch.ops.front_end import front_end
    from merpcr_tpu_torch.ops.margin_p2 import margin_p2
    from merpcr_tpu_torch.ops.verify_p1 import verify_p1

    wrappers = {"front_end": front_end, "expand": expand,
                "verify_p1": verify_p1, "margin_p2": margin_p2}
    t_start = time.perf_counter()

    # 1. device
    name = torch.cuda.get_device_name(0)
    card = smi()
    emit({"phase": "device", "name": name, "count": torch.cuda.device_count(),
          "nvidia_smi": card})

    # 2. build
    t0 = time.perf_counter()
    logs = kernels.build()
    ptxas = {k: [ln.split("ptxas info    : ")[-1] for ln in v.splitlines()
                 if "registers" in ln] for k, v in logs.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "compiled": sorted(logs), "ptxas": ptxas})

    with tempfile.TemporaryDirectory() as tmp:
        # 3. workload
        t0 = time.perf_counter()
        sts, fa, n, expect = make_workload(tmp, args.seed, args.mbp, args.nsts,
                                           args.planted)
        emit({"phase": "workload", "seconds": time.perf_counter() - t0,
              "genome_bp": n, "sts": args.nsts, "planted_lines": len(expect)})

        eng = MerPCR()
        t0 = time.perf_counter()
        check(eng.load_sts_file(sts), "STS load failed")
        t_table = time.perf_counter() - t0
        t0 = time.perf_counter()
        recs = eng.load_fasta_file(fa)
        t_fasta = time.perf_counter() - t0
        check(len(recs) == 1 and len(recs[0].sequence) == n, "FASTA load")

        # 4. kernels
        res = phase_kernels(eng, recs, card)

        # 5. end to end
        cold, hits_cold, t_cold = search_bytes(eng, recs)
        for w in wrappers.values():
            w.launches = 0
        torch.cuda.reset_peak_memory_stats()
        warm, hits, t_warm = search_bytes(eng, recs)
        launches = {k: w.launches for k, w in wrappers.items()}
        peak = torch.cuda.max_memory_allocated()
        check(warm == cold and hits == hits_cold, "warm search differs from cold")
        lines = set(warm.splitlines())
        missing = [e for e in expect if e not in lines]
        check(not missing, f"{len(missing)} planted lines missing, e.g. {missing[:3]}")
        check(all(launches.values()), f"a kernel never launched: {launches}")
        cpu = MerPCR(device="cpu")
        check(cpu.load_sts_file(sts), "STS load failed (cpu)")
        cpu_out, _, t_cpu = search_bytes(cpu, recs)
        check(cpu_out == warm, "card output differs from the CPU (plain) output")
        emit({"phase": "end2end", "card": card, "genome_bp": n, "hits": hits,
              "planted_found": len(expect), "cold_s": t_cold, "warm_s": t_warm,
              "warm_mbp_per_s": n / 1e6 / t_warm, "cpu_plain_s": t_cpu,
              "table_compile_s": t_table, "fasta_load_s": t_fasta,
              "peak_mem_bytes": peak, "launches": launches,
              "equal_to_cpu": True})
        emit({"phase": "breakdown", "card": card, **breakdown(eng, recs)})

        # 6. golden
        data = os.path.join(ROOT, "tests", "data")
        g_sts, g_fa = os.path.join(data, "test.sts"), os.path.join(data, "test.fa")
        g = MerPCR()
        check(g.load_sts_file(g_sts), "golden STS load failed")
        api, _, _ = search_bytes(g, g.load_fasta_file(g_fa))
        check(api == GOLDEN_LINE + "\n", f"golden API output {api!r}")
        cli = subprocess.run(
            [sys.executable, "-m", "merpcr_tpu_torch", g_sts, g_fa],
            cwd=ROOT, capture_output=True, text=True, timeout=300,
        )
        check(cli.returncode == 0 and cli.stdout == GOLDEN_LINE + "\n",
              f"golden CLI rc={cli.returncode} out={cli.stdout!r} "
              f"err={cli.stderr[-2000:]}")
        emit({"phase": "golden", "api": True, "cli": True})

    for k, r in res.items():
        r["launches"] = launches[k]
    emit({"kernels": [res[k] for k in wrappers], "card": card,
          "seconds": time.perf_counter() - t_start})
    print(smi())
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
