"""``python -m zipkin_tpu_torch.lint`` entry point."""

import sys

from zipkin_tpu_torch.lint.cli import main

if __name__ == "__main__":
    sys.exit(main())
