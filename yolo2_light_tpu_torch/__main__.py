import sys

from .apps.cli import main

sys.exit(main())
