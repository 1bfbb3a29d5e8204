#!/usr/bin/env python3
"""Run one cell of the benchmark once, on one CUDA card, and print its
result as the last line of standard output:

    python3 pcr_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``--trace 0`` prints the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics (with the profiler's ``busy_s``, ``window_s`` and
``breakdown``). Either way the run checks every search's lines against the
plain reference (``reference/mepcr.py``) once the window has closed, and
prints each number compared beside its limit, last. ``--control 1`` puts the
reference, with the guarantee that the traffic's ``control`` breaks, in the
program's place, and judges it the same way: it must come out not correct.

A machine with no card, or fewer than the cell asks for, gets an error and
no result: nothing falls back to the CPU.
"""

import time

T0 = time.perf_counter()  # noqa: E402 - set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# run as a script, Python puts this directory first on the path, where its
# modules would shadow the standard library's (trace): import them as
# pcr_bench.* from the checkout's root instead
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != BENCH_DIR]
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from pcr_bench import compare, generate, harness, spec  # noqa: E402

# top-level module names that may not be loaded when the result is printed
FORBIDDEN = ("jax", "jaxlib", "flax", "merpcr_tpu")
# build and kernel caches at fixed places inside the checkout
CACHES = {"CUDA_CACHE_PATH": "cuda", "TRITON_CACHE_DIR": "triton"}


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card_error(chips: int):
    """Why this machine cannot run the cell, or None."""
    import torch

    if not torch.cuda.is_available():
        return "no CUDA card: the benchmark runs on the card only"
    if torch.cuda.device_count() < chips:
        return f"the cell needs {chips} cards, this machine has {torch.cuda.device_count()}"
    return None


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def reference_lines(inp, cfg: dict, settings: list, device, broken=None) -> list:
    """The reference's lines for each of ``settings`` (each updated by
    ``broken`` for the control)."""
    import torch

    from pcr_bench.reference import mepcr

    ent = mepcr.Entries(inp.sts, cfg["wordsize"]).to(device)
    genome = torch.from_numpy(inp.genome).to(device)
    starts = torch.from_numpy(inp.starts).to(device)
    lengths = torch.from_numpy(inp.lengths).to(device)
    out = []
    for s in settings:
        s = {**s, "three_prime_match": cfg["three_prime_match"],
             "iupac_mode": cfg["iupac_mode"], **(broken or {})}
        rows = mepcr.search(genome, starts, lengths, ent, s["margin"], s["mismatches"],
                            s["three_prime_match"], bool(s["iupac_mode"]))
        out.append(mepcr.lines(rows.cpu(), inp.labels, ent, inp.sts))
    return out


def judge(inp, cfg: dict, outputs: list, refs: list) -> tuple:
    planted = [inp.expected(s["mismatches"], s["margin"], cfg["iupac_mode"])
               for s in inp.searches]
    return compare.judge_all(outputs, refs, planted, inp.labels)


def _quartiles(ms: list) -> dict:
    ms = sorted(ms)
    return {q: ms[min(len(ms) - 1, int(f * len(ms)))] for q, f in
            (("min", 0), ("p25", 0.25), ("p50", 0.5), ("p75", 0.75), ("p95", 0.95), ("max", 1))}


def loaded_forbidden() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def result(correct: bool, attempted: int, failed: int, metrics: dict, device: dict,
           checks: dict, extra: dict) -> int:
    bad = loaded_forbidden()
    if bad:
        say(f"modules that the benchmark may not load are loaded: {bad}")
        return 3
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device, **extra,
           "checks": {k: {"value": v, "limit": compare.LIMITS[k]} for k, v in checks.items()}}
    for k, v in checks.items():
        say(f"check {k} {v} limit {compare.LIMITS[k]}")
    print(json.dumps(out), flush=True)
    return 0


def control(cell, args, device) -> int:
    """The reference with the traffic's ``control`` settings in the
    program's place, one search per setting, judged as a run is."""
    inp = generate.make_inputs(cell.config, cell.traffic, args.seed, cell.dir)
    refs = reference_lines(inp, cell.config, inp.searches, device)
    bad = reference_lines(inp, cell.config, inp.searches, device, cell.traffic["control"])
    outputs = [(i, "".join(line + "\n" for line in b)) for i, b in enumerate(bad)]
    checks, failed = judge(inp, cell.config, outputs, refs)
    dev = {"platform": "control", "kind": str(device), "count": 0, "memory_peak_bytes": 0}
    return result(failed == 0, len(outputs), failed, {}, dev, checks,
                  {"control": cell.traffic["control"]})


class Context:
    """What a loop (``loops/<loop>.py``) is handed: the cell, its inputs, the
    device, the run to fill, and the card's clock and memory."""

    def __init__(self, cell, inp, device: str, on_card: bool, trace: bool, run):
        self.cell, self.inp, self.device, self.run = cell, inp, device, run
        self.trace = trace  # spans and counters around the program
        self.profile = trace and on_card  # and the profiler over a segment
        self.on_card = on_card
        self.t0 = T0

    def sync(self) -> None:
        if self.on_card:
            import torch

            torch.cuda.synchronize()

    def peak_bytes(self) -> int:
        if not self.on_card:
            return 0
        import torch

        return torch.cuda.max_memory_allocated()

    def empty_cache(self) -> None:
        if self.on_card:
            import torch

            torch.cuda.empty_cache()


def main(argv=None, device=None, root=ROOT) -> int:
    """One run of the cell named by ``argv``. ``device`` None: the card,
    which must be there; tests pass ``"cpu"`` to drive a run without it."""
    args = parse(argv)
    for var, sub in CACHES.items():
        os.environ[var] = os.path.join(BENCH_DIR, "_cache", sub)
    os.environ.pop("MERPCR_TPU_TRACE", None)  # the program's own trace hook
    cell = spec.Cell(root, args.workload)
    on_card = device is None
    if on_card:
        err = card_error(cell.chips)
        if err:
            say(err)
            return 2
        device = "cuda"
    import torch

    if on_card:
        torch.cuda.reset_peak_memory_stats()
    if args.control:
        return control(cell, args, device)
    cfg, run = cell.config, harness.Run(cell, args.seconds)
    run.steps["import_torch"] = time.perf_counter() - T0
    t0 = time.perf_counter()
    inp = generate.make_inputs(cfg, cell.traffic, args.seed, cell.dir)
    run.steps["make_inputs"] = time.perf_counter() - t0
    ctx = Context(cell, inp, device, on_card, bool(args.trace), run)
    outputs = cell.loop().drive(ctx)
    every = (cell.traffic.get("plants", {}).get("boundary") or {}).get("every")
    off_edge = [t for t in run.info.get("record_tile_len", []) if every and t % every]
    if off_edge:
        say(f"note: record tiles of {off_edge} bases do not end on the boundary plants "
            f"(every {every} bases)")
    checks, failed = judge(inp, cfg, outputs, reference_lines(inp, cfg, inp.searches, device))
    metrics = {}
    for m in cell.per_layer if args.trace else cell.end_to_end:
        value = cell.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": 1 if on_card else 0, "memory_peak_bytes": run.peak_bytes}
    extra = {"card": power_limit() if on_card else "none",
             "samples": {"window_searches": len(run.window),
                         "segment_searches": len(run.segment)},
             "setup_steps": run.steps, **run.info,
             "window_ms": _quartiles([s.ms for s in run.window])}
    if run.trace is not None:
        dev.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
        top = sorted(run.trace.device_ops.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(run.trace.idle_by_span.items(), key=lambda kv: -kv[1])[:10]
        extra["breakdown"] = {"device_ops": [list(kv) for kv in top],
                              "idle_gaps": [list(kv) for kv in gaps]}
    return result(failed == 0, len(outputs), failed, metrics, dev, checks, extra)


if __name__ == "__main__":
    sys.exit(main())
