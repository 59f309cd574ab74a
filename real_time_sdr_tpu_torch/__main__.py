"""``python -m real_time_sdr_tpu_torch``: the pipe CLI (``cli.py``)."""

import sys

from real_time_sdr_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
