import sys

from magicsoup_tpu_torch.analysis.cli import main

sys.exit(main())
