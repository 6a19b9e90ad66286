"""Benchmarks of the port: ``figures`` runs the paper's evaluation
suite (Figs 3-9 and the regret curve) on the card."""
