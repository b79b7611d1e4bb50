"""CLI entry: `python -m factorvae_tpu_torch.analysis [paths] [--project]
[--format human|json] [--show-suppressed]`."""

import sys

from factorvae_tpu_torch.analysis.engine import main

if __name__ == "__main__":
    sys.exit(main())
