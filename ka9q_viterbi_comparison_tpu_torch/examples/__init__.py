"""Examples of the port's entry points (run with ``python -m``)."""
