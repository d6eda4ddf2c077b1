"""Top-level CLI: ``python -m cme213_tpu_torch <workload> [args...]``."""

import sys

from .models import dispatch

if __name__ == "__main__":
    sys.exit(dispatch(sys.argv[1:]))
