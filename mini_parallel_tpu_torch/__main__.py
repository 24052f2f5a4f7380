import sys

from mini_parallel_tpu_torch.cli import main

sys.exit(main())
