"""Command-line programs over the port (``python -m`` or ``torchrun -m``)."""
