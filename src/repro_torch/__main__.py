"""``python -m repro_torch``: the port's command line (see ``cli``)."""
import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
