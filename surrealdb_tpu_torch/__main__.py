import sys

from surrealdb_tpu_torch.cli import main

sys.exit(main())
