import sys

from slurm_bridge_tpu_torch.sim.cli import main

sys.exit(main())
