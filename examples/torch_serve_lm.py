"""Batched serving example: continuous batching over a reduced model, on
``cuda:0`` (``--device cpu`` on a host without a card; ``--no-reduced``
for the full architecture).

  PYTHONPATH=src python examples/torch_serve_lm.py --arch qwen3-1.7b --requests 8
"""

import sys

from repro_torch.launch.serve import main

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
