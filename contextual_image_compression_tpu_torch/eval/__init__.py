"""Evaluation: the codec's bpp and rate-control sweeps (harness.py), the
autoencoder's (ae_eval.py) and their artifacts (plots.py)."""
