import sys

from ktransformers_tpu_torch.cli.main import main

sys.exit(main())
