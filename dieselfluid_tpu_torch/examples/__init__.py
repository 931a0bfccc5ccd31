"""Twins of the repo's examples on the port: `dam_break` and
`fit_material` (python -m dieselfluid_tpu_torch.examples.<name> [--cpu])."""
