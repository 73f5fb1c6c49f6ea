"""Inputs drawn from ``--seed``: states, campaign keys, kill planes, samples."""
