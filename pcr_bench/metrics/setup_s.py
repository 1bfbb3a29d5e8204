"""Seconds from the run's start to its first timed search: import torch, the
CUDA context, the inputs made and written, the STS load and compile, the
FASTA load, the fresh engine's first search and the warm-up."""


def read(run):
    return run.setup_s or None
