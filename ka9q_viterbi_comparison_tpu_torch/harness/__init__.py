"""Benchmark harness of the port: phase-timed runs that emit the reference's
JSON schema (``bench``, ``runner``) and tracing helpers (``profiling``)."""
