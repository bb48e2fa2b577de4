"""Diagnostics: evaluation metrics and stability heuristics (port of
`kanodes_tpu/diag/`; `metrics.py` is a copy)."""
