"""``python -m maxmq_tpu_torch`` — the process entry point."""

import sys

from .cli import main

sys.exit(main())
