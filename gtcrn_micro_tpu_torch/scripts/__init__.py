"""The port's measuring tools, one module for each of the repository's root
``scripts/`` that measured the JAX package's serving and training (same
file names; run as ``python -m gtcrn_micro_tpu_torch.scripts.<name>``).
Each takes ``--device`` (default ``cuda``; ``cpu`` runs the plain versions,
for a check of the control flow, not for a time) and returns its results
from ``main(argv)`` as well as printing them."""
