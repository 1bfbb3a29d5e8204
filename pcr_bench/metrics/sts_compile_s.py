"""Seconds of ``MerPCR.load_sts_file``: the STS parse and table compile."""


def read(run):
    return run.setup_spans.get("sts_compile_s")
