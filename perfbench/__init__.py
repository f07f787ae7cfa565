"""The benchmark of the PyTorch/CUDA port (``repro_torch``) on one H100.

``run.py`` is the entry point; ``README.md`` says how a cell, a traffic
mix, a configuration or a metric is added by adding files.
"""
