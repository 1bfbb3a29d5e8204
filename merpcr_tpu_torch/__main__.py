"""Module entry point: ``python -m merpcr_tpu_torch`` (reference __main__.py:5-8)."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
