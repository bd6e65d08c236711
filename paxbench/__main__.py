import sys

from paxbench.run import main

sys.exit(main())
