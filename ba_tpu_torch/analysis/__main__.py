"""``python -m ba_tpu_torch.analysis``: the port's ba-lint entry point."""

import sys

from ba_tpu_torch.analysis.driver import main

if __name__ == "__main__":
    sys.exit(main())
