import sys

from mcaat_tpu_torch.cli import main

sys.exit(main())
