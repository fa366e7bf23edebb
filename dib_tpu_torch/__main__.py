"""``python -m dib_tpu_torch`` entry point."""

import sys

from dib_tpu_torch.cli import main

sys.exit(main())
