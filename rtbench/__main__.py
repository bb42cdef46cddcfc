"""``python3 -m rtbench``: see ``rtbench/run.py``."""

import sys

from rtbench.run import main

sys.exit(main())
